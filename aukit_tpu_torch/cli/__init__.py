"""cli subpackage — counterpart of ``aukit_tpu.cli``: the four programs,
run as ``python -m aukit_tpu_torch.cli.<name>``. Each takes ``--device
{cuda,cpu}`` (the card by default; without one, "cuda" raises), where the
JAX package's programs take their device from ``JAX_PLATFORMS``."""

DEVICES = ("cuda", "cpu")
