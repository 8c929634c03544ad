"""Positive: locks, open handles, lambdas, and CUDA tensors flowing
into framed sends — pickle raises, or (for CUDA tensors) the send
hides a device->host copy and the peer needs a card to unpickle."""

import threading

import torch


def ship_lock(conn):
    lock = threading.Lock()
    conn.send(lock)             # unpicklable


def ship_file(conn):
    with open("stats.log") as handle:
        conn.send(handle)       # unpicklable


def ship_code(conn):
    conn.send(lambda x: x + 1)  # unpicklable


def ship_device(conn):
    arr = torch.zeros((4,), device="cuda")
    conn.send(arr)              # hidden device->host copy
