"""CPU tests of the benchmark harness (and, marked `cuda`, its control
on the card)."""
