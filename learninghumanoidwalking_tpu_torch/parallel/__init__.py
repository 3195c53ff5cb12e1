"""Data-parallel training over torch.distributed (mesh.py) and its dry run (dryrun.py)."""
