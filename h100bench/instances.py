"""Instance keys and batches, whatever the problem family.

An instance batch is a tuple of tensors whose first dimension is the
lane, made by the family's ``make`` (``problems/<family>.py``) from a
generator seed. Every run of a cell solves the same instances: a batch's
seed comes from the configuration's ``instance_seed`` and the batch's
place; the run's ``--seed`` draws, for each batch, an order of its rows
and columns (a second generator), so every seed gives the program the
same work in another order, and no two seeds give it the same inputs.
"""

import torch


def key(seed: int, stream: int, index: int) -> int:
    """A 63-bit generator seed for instance batch ``index`` of ``stream``
    in the run of ``seed`` (splitmix64 of the three)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9
         + int(index) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return x & 0x7FFFFFFFFFFFFFFF


def take(data, index):
    """The lanes ``index`` (a tensor of positions) of every tensor of a
    batch."""
    return tuple(t[index] for t in data)


def cat(batches):
    """One batch of the lanes of ``batches``, in order."""
    return tuple(torch.cat(parts) for parts in zip(*batches))
