"""solverlint fixture for the port: host-sync-in-hot-path over torch. Never
imported — parsed only.

Seeds the torch host copies (`.item()`, `.cpu()`, `.numpy()`, `.tolist()`)
and the coercions of kernel wrappers' outputs and of torch producers. A
chain (`x.cpu().numpy()`) is one finding, a value already on the host is
none, and the pragma'd and shape-read twins must NOT be flagged.
"""

import numpy as np
import torch


def bad_item(t, items):
    compat, key = feasibility(t, items)  # noqa: F821 — fixture, parsed only
    return compat.sum().item()


def bad_cpu_chain(t, items, compat, key):
    takes, leftovers, state = pack_scan(t, items, compat, key, n_slots=8)  # noqa: F821
    return takes.cpu().numpy()


def bad_tolist(flat):
    out = flat_outputs(*flat)  # noqa: F821
    return out.tolist()


def bad_numpy(state, t, args):
    carry = recredit(state, t, *args)  # noqa: F821
    return carry[0].numpy()


def bad_int_of_torch_producer(x):
    n = torch.count_nonzero(x)
    return int(n)


def bad_asarray(t, items, compat, key):
    takes, leftovers, state = pack_scan(t, items, compat, key, n_slots=8)  # noqa: F821
    return np.asarray(leftovers)


def ok_host_after_copy(t, items):
    compat, key = feasibility(t, items)  # noqa: F821
    host = compat.cpu()  # solverlint: ok(host-sync-in-hot-path): fixture — the one deliberate download
    return host.tolist()  # a host tensor: no finding


def ok_shape_read(t, items):
    compat, key = feasibility(t, items)  # noqa: F821
    return int(compat.shape[0])  # static metadata, not a sync: must NOT be flagged


def ok_plain_numpy(xs):
    return np.asarray(xs).tolist()  # never a device value: must NOT be flagged
