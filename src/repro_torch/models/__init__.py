"""Model parameter trees (the forward pass is not yet ported)."""
