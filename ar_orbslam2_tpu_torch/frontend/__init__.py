"""Feature frontend: ORB extraction (pyramid FAST + oriented BRIEF)."""
