"""End-to-end pipeline of the PyTorch port: `reconstruct`, its checkpoint
store and the per-pair scan meshes."""
