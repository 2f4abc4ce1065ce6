"""Model construction and frame-batched inference."""
