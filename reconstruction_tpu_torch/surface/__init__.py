"""Surfacing of the PyTorch port: the dense-grid Poisson solve on a device,
marching tetrahedra and the mesh cleanup on the host (numpy and the
native library), and vertex texturing."""
