"""Box geometry and NMS on torch tensors."""
