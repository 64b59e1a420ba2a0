"""The benchmark of ``production_stack_tpu_torch`` on one NVIDIA H100.

``python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (run.py). The
yardstick lives here, where the program cannot change it: the traffic
generator (traffic.py, client.py), the window's arithmetic
(measures.py), the weights (weights.py), the plain reference
(reference.py) and the check of what was served (judge.py), the
operation and byte counts with the card's peaks (work.py), the profiled
slice (trace.py) and each metric's reader (metrics/). serve.py alone
imports the program.
"""
