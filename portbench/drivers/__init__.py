"""Drivers, one file each, found by a traffic mix's ``driver`` field."""
