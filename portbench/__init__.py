"""The benchmark of aero_gnn_tpu_torch on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Configurations, traffic mixes, per-cell limits and metric readers are
files of their own under this folder, found by the names the manifest
gives. The yardstick (inputs, reference, FLOP and byte counts, trace
reduction, comparison) lives here too; from the port the benchmark takes
only the system under test.
"""
