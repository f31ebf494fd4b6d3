"""One driver a traffic kind (the ``kind`` of a traffic file): it builds
the system under test from the configuration, drives it through the
measured window, and hands the comparison what the program produced."""
