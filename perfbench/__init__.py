"""The benchmark of the PyTorch / CUDA port (``dropout_hamiltonian_montecarlo_tpu_torch``).

One command runs one cell once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that measures (data from the seed, the flop and byte counts, the
ESS, the reading of the profiler's trace, the plain references and the
comparison that decides ``correct``) lives here, apart from the program.
"""
