"""The benchmark of ``stc_tpu_torch`` on NVIDIA H100 cards.

``python3 stcbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is data found by name:
``configs/<config>.json`` (the model's sizes and session settings),
``workloads/<traffic>.json`` (the traffic mix's parameters) and
``metrics/<metric>.py`` (one reader per per-layer metric).  A model
family is code found by name: ``families/<family>.py`` builds the program
and its vision reference and brings its language model (``lms/``: the
LM's sizes, reference check of the pages, work counts and ops).  The
yardstick lives here too: the traffic generator (``traffic.py``), the
seeded weights (``weights.py``), the frozen operation and byte counts and
the H100 peaks (``counts.py``), and the plain float32 reference with its
comparison (``reference/``, ``compare.py``).  Nothing here imports JAX or
the JAX package; ``reference/`` imports nothing of the port either.
"""
