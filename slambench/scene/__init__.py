"""The benchmark's frames: a seeded room (room.py) rendered on the device
(cast.py) along a fixed arc."""
