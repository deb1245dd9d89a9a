"""The LM stack of the port (``repro/models``): the dense family's layers
(:mod:`.layers`) and model API (:mod:`.api`)."""
