"""The calls into the program that a traffic mix drives, one module an entry.

Each module has `setup(mix, data, device) -> state`, the set-up a process
makes once, and `request(state, data, rec) -> answer`, one request: it
starts from the map's numpy arrays, builds the graph on the device, calls
the entry, and ends when the answer is numpy arrays and numbers on the
host. Nothing derived from the map is kept between requests.
"""
