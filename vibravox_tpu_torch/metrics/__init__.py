"""Speech-enhancement metrics of the port."""
