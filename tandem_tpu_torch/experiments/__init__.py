"""Torch counterparts of the JAX package's Pallas probe scripts
(``experiments/pallas_gather_probe.py``, ``pallas_shuffle_probe.py``,
``bench_idxchain.py``), at the probes' own shapes, on one NVIDIA GPU."""
