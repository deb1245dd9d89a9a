"""The window engine of the port: :mod:`.enclave` (executor, sealed
windows) and :mod:`.pipeline` (stages, routing, ingress/egress)."""
