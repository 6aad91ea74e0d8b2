"""Fixture: every form the host-sync and reduction passes flag, an inline
escape, a function on host tensors, a seam and a host-only function.
tests/test_torch_tidy.py asserts the findings exactly: edit both
together."""

import torch


def create_transfers_fast(events):
    """Stands in for a kernel wrapper: its result lies on the card."""
    return events


def bad_dispatch(events):
    codes = create_transfers_fast(events)
    n = codes.item()
    host = codes.cpu()
    rows = codes.tolist()
    arr = codes.numpy()
    flag = bool(codes)
    k = int(codes[0])
    v = float(codes.sum())
    same = torch.equal(codes, codes)
    back = codes.to("cpu")
    back2 = codes.to(torch.device("cpu"))
    pinned = torch.empty(4, dtype=torch.uint32, pin_memory=True)
    pinned.copy_(codes)
    pinned.copy_(codes, non_blocking=True)
    if codes.any():
        n += 1
    while (codes > 0).all():
        break
    y = 1 if codes[0] else 0
    torch.cuda.synchronize()
    ev = torch.cuda.Event()
    ev.synchronize()
    torch.cuda.current_stream().synchronize()
    return n, host, rows, arr, flag, k, v, same, back, back2, y


def bad_reduce(table, idx):
    vals = torch.zeros(4, dtype=torch.float32, device="cuda")
    table.index_add_(0, idx, vals)
    total = vals.sum()
    w = idx.float()
    return total, w


def host_values(events):
    t = torch.from_numpy(events)
    if t.any():
        return t.numpy(), t.tolist(), bool(t[0])
    return None


def escaped(events):
    codes = create_transfers_fast(events)
    return codes.item()  # tidy: allow=host-sync — fixture: the inline escape


def finish(events):
    codes = create_transfers_fast(events)
    return codes.cpu().numpy()


def plain(events):
    return events.item()
