"""Host utilities of the port: the CUDA cards' data-sheet rates."""
