"""Renderers of the plain reference that live under ``models/`` in the
port (the traffic names a renderer by its module inside the package)."""
