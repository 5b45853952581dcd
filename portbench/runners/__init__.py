"""General runners, one per mix ``kind``: each reads any mix file of its
kind, runs the window and compares what the window produced with the
plain reference."""
