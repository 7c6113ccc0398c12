"""Plain reference of the benchmark (float32 torch with TF32 off, numpy).
One module a scene field, named by each configuration's `reference` key
and found by file (registry.reference): `imap.py`, the iMAP* field. Common
to every field: the camera (`camera.py`) and the front-end geometry
(`frontend.py`). Imports nothing of the program."""
