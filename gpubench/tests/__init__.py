"""CPU tests of the benchmark (``gpubench/``); the one that needs a card
carries the ``cuda`` marker."""
