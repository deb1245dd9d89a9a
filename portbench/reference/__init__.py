"""Plain float32 references of what the cells run (imports only torch)."""
