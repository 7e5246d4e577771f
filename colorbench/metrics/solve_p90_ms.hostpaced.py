"""solve_p90_ms.hostpaced: the number ``solve_p90_ms`` reads, kept as a
per-layer metric for the cells whose device idles much of the time, where
the tail is too noisy to bound."""
from pathlib import Path

from colorbench.harness import load_reader

read = load_reader(Path(__file__).resolve().parents[1], "solve_p90_ms")
