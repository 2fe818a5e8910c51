"""Traffic: ``<mix>.json`` holds a mix's parameters and names its
``mode``; ``<mode>.py`` is the code that runs every mix of that mode
(``run(ctx) -> harness.Outcome``)."""
