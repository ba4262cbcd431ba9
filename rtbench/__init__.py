"""The benchmark of scheme_raytrace_torch on NVIDIA H100 cards.

`python -m rtbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once (rtbench/README.md).
"""
