"""The examples of ``examples/``, on the PyTorch port.

Each script draws its data (and any random weights) on the host, so that a
run on the card and one on the CPU see the same numbers; computes on
``--device`` (``cuda`` unless told otherwise); prints what the reference
script prints; and returns those figures from ``main(argv)``.
"""
