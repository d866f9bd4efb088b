"""paddle_tpu_torch.vision — the vision models of the port."""
