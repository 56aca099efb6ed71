"""gemm_ms_per_img.<cells> (ms): device time of the matrix products (kernels
under aten::mm, addmm, bmm, baddbmm, matmul, linear; by name gemm / nvjet /
cutlass where no operator is linked) per image of the traced batches."""

from benchmark import kernels


def read(r):
    s = r.trace.seconds(kernels.is_matmul)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
