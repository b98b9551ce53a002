"""Data layer: sample indexing, synthetic stacks, the tile dataset and the
device-resident stack cache."""
