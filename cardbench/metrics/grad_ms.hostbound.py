"""``grad_ms``'s reading, in the cells whose step the host's launches hold
(their end-to-end rate is ``train_tokens_per_s.hostbound``)."""

from cardbench.harness import metric_reader

read = metric_reader("grad_ms")
