"""The port's benchmark: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, driven by ``BENCHMARK.json`` at the checkout's
root. Configurations, traffic mixes, drivers, per-layer metrics and limits
are files found by name under this folder."""
