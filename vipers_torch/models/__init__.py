"""Model families (ViT so far)."""
