"""The port side of each configuration's model: which of the program's
experiment configurations runs it in each traffic mode, and with what
arguments."""
