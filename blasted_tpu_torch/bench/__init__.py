"""The port's benchmarks on the card: the counterparts of ``bench.py``
(:mod:`.roofline`) and ``scripts/bench_amg.py`` (:mod:`.amg`), with their
measurement plumbing in :mod:`.common`.  Run on a machine with a CUDA card::

    python3 -m blasted_tpu_torch.bench.roofline
    python3 -m blasted_tpu_torch.bench.amg

Each refuses to run without a card (exit code 2).  Nothing is imported from
the JAX package.
"""
