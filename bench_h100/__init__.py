"""The benchmark of ``nirgan_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell once and prints one JSON line:

    python3 -m bench_h100 --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root lists the cells, the end-to-end
metrics with their bounds and the per-layer metrics.  Everything else is
found by name: a configuration in ``configs/<config>.yaml``, a traffic mix in
``traffic/<traffic>.json``, a cell's settings and correctness limits in
``workloads/<cell>.json``, the loop that drives it in
``drivers/<driver>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The yardstick (traffic generation, FLOP and byte
counts, peaks, trace reduction, the plain reference and the comparison that
decides ``correct``) lives here and imports nothing of the program but what
it measures.
"""
