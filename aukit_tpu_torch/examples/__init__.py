"""End-to-end serving loops over the port's batched engines, counterparts of
the repository's ``examples/`` scripts. Each runs as a module and takes the
JAX script's positional arguments, plus ``--device {cuda,cpu}`` (the card by
default; without one it raises):

    python -m aukit_tpu_torch.examples.batch_server [lanes] [seconds]
    python -m aukit_tpu_torch.examples.flac_radio_fleet [stations] [seconds]
    python -m aukit_tpu_torch.examples.mixed_fleet_server [stations] [seconds] [rotations]

For the same arguments each feeds the same bursts (the same numpy RNG calls
in the same order) and prints the JAX script's lines; only the wall time and
the realtime factor differ. ``main()`` also returns what it prints as a dict.
"""
