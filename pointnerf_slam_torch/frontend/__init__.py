"""The sparse visual front-end of weak-depth (RGB-only) mode."""
