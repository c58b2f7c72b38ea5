"""The benchmark harness: cells, runners, traffic and the yardstick."""
