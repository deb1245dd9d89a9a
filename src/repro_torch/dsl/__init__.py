"""The DSL of the port: only the named terminal reducers so far."""
