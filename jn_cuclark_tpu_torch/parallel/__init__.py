"""Classification over several devices (parallel/mesh.py)."""
