"""Kernel workloads and the schedule IR (copies of ``repro.core``'s, so both
packages derive the same workload keys and default schedules)."""
