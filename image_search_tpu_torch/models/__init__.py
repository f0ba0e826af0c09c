"""CLIP towers, weights and the embedding engine of the port."""
