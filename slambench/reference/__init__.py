"""Plain reference of the benchmark (float32 torch with TF32 off, numpy):
the iMAP* field, renderer, losses and Adam (imap.py), the steps it
follows (steps.py) and the front-end geometry (frontend.py). Imports
nothing of the program."""
