"""The benchmark's harness: it finds a cell's configuration, traffic,
driver and per-layer readers by name, runs the cell once and prints the
result line."""
