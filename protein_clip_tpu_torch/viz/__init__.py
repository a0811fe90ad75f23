"""Run-artifact figures."""
