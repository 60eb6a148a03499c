"""Drivers of the traffic kinds, each found by the name a traffic file gives."""
