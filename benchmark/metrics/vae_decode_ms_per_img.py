"""vae_decode_ms_per_img, vae_decode_ms_per_img.<cells> (ms): device time of the convolution operators
(aten::convolution, _convolution, cudnn_convolution[_transpose]; the VAE
decode is the only convolution in the generation cells) per image of the
traced batches."""

from benchmark import kernels


def read(r):
    s = r.trace.seconds(kernels.is_conv)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
