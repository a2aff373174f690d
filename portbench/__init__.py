"""portbench: the benchmark of dipole_tpu_torch on an NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json and prints one JSON line.
Nothing here imports jax or the JAX package; reference/ imports nothing of
the port either.
"""
