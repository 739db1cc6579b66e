"""The yardstick: registry, traffic generator, statistics, tracing, the
comparison that decides `correct`, and the runner."""
