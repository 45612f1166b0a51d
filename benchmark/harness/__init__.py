"""The benchmark's harness: the lookup of cells, configurations, traffic
mixes and metric readers by name, the seeded inputs and weights, the
closed loops that drive the program, the tracing, the arithmetic of
operations and bounds, and the comparison that decides ``correct``."""
