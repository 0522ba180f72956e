"""Several processes: data-parallel training (mesh.py) and the offline
tools' work split (serving.py), one process per card."""
