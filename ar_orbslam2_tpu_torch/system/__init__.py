"""Frame, Tracking state machine, SlamSystem facade."""
