"""See :mod:`.ops` (wrapper) and :mod:`.ref` (plain torch version)."""
