"""The engines of the port: :mod:`.enclave` (executor, sealed chunks and
windows), :mod:`.pipeline` (stages, the window engine and the per-chunk
oracle engine, ingress/egress), :mod:`.router` (chunk routing) and
:mod:`.observable` (the cleartext operator chain the DSL lowers to)."""
