"""Protocol roles: the device-resident Server and the Client."""
