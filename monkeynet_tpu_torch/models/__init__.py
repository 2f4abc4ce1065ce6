"""Networks of the forward path, as torch.nn.Modules."""
