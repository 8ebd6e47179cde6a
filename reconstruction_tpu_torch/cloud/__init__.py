"""Cloud optimization of the PyTorch port: neighbor grids, SOR, normals,
MLS and cross-view dedup, on the points' device or on the native host
path (cloud/backend.py)."""
