"""Cell drivers, one per kind of traffic, found by the `driver` key of a traffic file."""
