"""Parallel layouts of the port over torch.distributed: meshes and their
collectives (mesh.py), tensor-parallel layouts (sharding.py), the pipeline
relay (pipeline.py) and a multi-process dry run (dryrun.py)."""
