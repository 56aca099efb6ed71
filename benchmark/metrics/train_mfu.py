"""train_mfu (%): the train step's share of the chip's bf16 peak:
`flops.maskgit_train_flops` (the frozen copy of the port's arithmetic,
from the configuration and the traffic) x steps a second in the window's
steps that were not profiled (host clock) / 989 TFLOP/s."""

from benchmark import flops


def read(r):
    rate = r.layer.get("steps_per_s_untraced")
    if not rate:
        return None
    return 100.0 * r.layer["flops_per_step"] * rate / flops.PEAK_BF16
