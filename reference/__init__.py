"""Plain float32 PyTorch references of the networks the port trains,
written from their papers; the port's tests hold it to them."""
