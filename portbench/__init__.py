"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its deployment in
``configs/<name>.json``, its traffic in ``mixes/<name>.json`` (whose
``kind`` names the general runner in ``runners/`` that runs it), a model
in ``models/<name>.json``, and each per-layer metric's reader in
``metrics/<name>.py``.  The plain references that decide ``correct`` live
in ``reference/`` and import nothing of the port.
"""
