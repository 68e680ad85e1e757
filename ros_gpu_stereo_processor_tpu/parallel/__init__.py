"""Multi-chip parallelism (new in this engine — the reference is strictly
single-GPU/single-process, SURVEY.md §2 parallelism note).  Meshes, sharded
dense frontend (row bands with halo exchange; disparity slabs with
argmin-reduce), and distributed optimisation."""
