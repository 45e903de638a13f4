"""The plain reference the outputs are held to: the renderer's exact poses
and room (truth.py) and a frozen ORB extractor (orb/).  Nothing here
imports the program."""
