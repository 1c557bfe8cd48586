"""The dense models: parameter trees, forward, loss and decode."""
