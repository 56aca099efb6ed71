"""gen_mfu, gen_mfu.<cells> (%): the whole request's share of the chip's peak. The least
time an image could take at the published peaks (bf16 trunk and head FLOPs
at 989 TFLOP/s, f32 VAE-decode and T5 FLOPs at 67 TFLOP/s, reckoned by
`benchmark/flops.py` from the configuration and the traffic) over the time
an image took in the window's batches that were not profiled (host clock)."""


def read(r):
    rate = r.layer.get("img_per_s_untraced")
    if not rate:
        return None
    return 100.0 * r.layer["least_s_per_img"] * rate
