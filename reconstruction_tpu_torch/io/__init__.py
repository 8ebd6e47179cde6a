"""Host I/O of the PyTorch port: PLY reading and writing, image files."""
