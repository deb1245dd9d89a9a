"""Configuration of the port (only :class:`.base.SecureStreamConfig` so far)."""
