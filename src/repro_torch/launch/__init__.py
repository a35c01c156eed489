"""The LM's launch layer, as `repro.launch`: `train` (the trainer
and its CLI), `mesh` and `sharding` (DeviceMeshes and the sharding rules
as DTensor placements), `dryrun` (each cell's step on DTensors over a fake
process group: the collective census) and `roofline` (an H100 model)."""
