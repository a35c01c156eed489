"""Tokens that the window's calls decoded (each call's units: sessions
times steps), over the wall seconds from the first call's start to the
last call's return (the kept logits on the host): `flows_per_s.py`'s
reading, of the LM lane's units. Each call's copy of its sessions'
prompt states to the card is in it."""
from pathlib import Path

from portbench.harness import spec

read = spec.load(Path(__file__).with_name("flows_per_s.py"),
                 "portbench.metrics.flows_per_s").read
