"""Negative: plain data payloads — a lock used locally but not sent,
a CUDA tensor copied to host numpy at the boundary, and a CPU tensor."""

import threading

import torch

from handyrl_tpu_torch.utils.tree import tree_map_leaves


def ship_state(conn):
    lock = threading.Lock()
    with lock:
        payload = {"count": 1}
    conn.send(payload)


def ship_host(conn):
    arr = torch.zeros((4,), device="cuda")
    conn.send(arr.cpu().numpy())  # the host copy crosses the wire


def ship_tree(conn, device):
    out = {"logits": torch.zeros((4,), device=device)}
    # the boundary idiom: a tree map over a host converter launders
    # the whole tree
    conn.send(("batch", tree_map_leaves(lambda t: t.cpu().numpy(), out)))
    conn.send(("meta", torch.zeros(3)))  # built on the CPU
