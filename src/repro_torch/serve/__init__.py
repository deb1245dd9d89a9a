"""LM serving on the port: prefill and greedy decode (:mod:`.engine`) and
the attested, sealed-prompt front (:mod:`.secure`)."""
