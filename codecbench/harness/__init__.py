"""The harness that drives the program under test (set-up, the measured
window, the traced window) and turns clocks, traces and counters into
metrics."""
