"""The launch layer: the one card's mesh (:mod:`.mesh`), the op-level
analyzer of a step on meta tensors (:mod:`.analysis`) and the dry run
over every (arch, shape) cell (:mod:`.dryrun`)."""
