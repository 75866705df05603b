"""The benchmark of the PyTorch/CUDA port ``algebraicmultigrid_tpu_torch``.

``python3 amgbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
its result as the last line of standard output.  Nothing here imports JAX
or the JAX package.
"""
