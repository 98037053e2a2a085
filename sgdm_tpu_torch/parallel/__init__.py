"""Training across ranks: the mesh and its collectives (`mesh`), starting
ranks (`launch`), FSDP over the flat train state (`fsdp`) and tensor
parallelism for the UNets (`tp`)."""
