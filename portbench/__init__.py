"""portbench: the benchmark of meshflow_tpu_torch on one NVIDIA H100.

Run a cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; see README.md.
"""
