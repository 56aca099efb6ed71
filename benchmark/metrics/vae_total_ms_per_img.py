"""vae_total_ms_per_img.<cells> (ms): device time of every kernel launched
inside the program's `muse.vae_decode` span (the VQ-GAN decode of the
final ids: its convolutions, norms, activations and copies) per image of
the traced batches. A program without the span reads nothing."""


def read(r):
    s = r.trace.seconds(lambda name, chain: "muse.vae_decode" in chain)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
