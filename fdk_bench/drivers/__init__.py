"""Cell drivers, one file each, named by a traffic mix's ``driver``."""
