"""Golden fixture: CKPT401 on PyTorch's in-place tensor methods.

Never imported — only parsed by the port's ckptlint. `EXPECT:RULE`
markers name the findings each line must produce.
"""


def bad_copy_into_reservation(cache, src):
    res = cache.reserve(1024)
    dst = res.tensor()
    dst[0:512].copy_(src[0:512])  # EXPECT:CKPT401
    return res


def bad_add_through_a_view(provider, delta):
    staged = provider.reservation.tensor()
    staged.view(delta.dtype).add_(delta)  # EXPECT:CKPT401
    staged.zero_()  # EXPECT:CKPT401


def bad_array_store(provider):
    out = provider.reservation.array("uint8", (16,))
    out[0:4] = 0  # EXPECT:CKPT401


def fine_copy_into_a_fresh_tensor(torch, src):
    dst = torch.empty_like(src)
    dst.copy_(src)
    dst.add_(1)
    return dst


def fine_read_of_a_reservation(cache):
    res = cache.reserve(16)
    return res.tensor().clone()


def _launch_d2h(provider, src):
    # the sanctioned lane: it enqueues the device-to-host copies
    provider.reservation.tensor()[0:4].copy_(src, non_blocking=True)
