"""Sealed checkpoints of the port (:mod:`.checkpoint`)."""
