"""The benchmark's own count of a step's work, from the configuration's
shapes and the graph's rows and edges: the model's floating-point
operations (``flops``) and each kernel layer's compulsory bytes (its
inputs read once and its outputs written once, whatever implements it).
One file per model, ``counts/<model>.py``, with ``step_counts``."""
