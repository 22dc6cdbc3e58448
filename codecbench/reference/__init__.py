"""The benchmark's frozen reference: plain PyTorch models, the seeded
weight and image recipes, and the comparison that decides `correct`.
Imports nothing of the program under test."""
