"""The benchmark of `pointnerf_slam_torch` on one NVIDIA H100: steady-state
SLAM cycles of the port's system, from data files found by name
(registry.py), checked against a plain reference (reference/).
Run: python -m slambench --workload <cell> --seed <n> --seconds <s>
--trace 0|1 (README.md)."""
