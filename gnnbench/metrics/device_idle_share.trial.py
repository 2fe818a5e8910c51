"""The card's idle share of a step of the traffic mode that ends this
file's name (``trace.idle_share_reader``)."""

from gnnbench.trace import idle_share_reader

read = idle_share_reader(__file__)
