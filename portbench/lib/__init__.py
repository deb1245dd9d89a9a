"""General harness code: configurations, traffic, drivers, traces, checks."""
