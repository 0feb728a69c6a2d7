"""Scenes, trajectories and the ToF simulator the port is replayed with."""
