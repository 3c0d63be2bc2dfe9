"""FLOP and byte counts of the benchmark's configurations, from shapes."""
