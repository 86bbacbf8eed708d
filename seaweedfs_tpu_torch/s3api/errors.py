"""S3 API error codes and XML error bodies.

Behavioral match of weed/s3api/s3api_errors.go: each error is
(Code, Description, HTTPStatusCode) rendered as the standard
<Error> XML document AWS clients parse.

The port of seaweedfs_tpu/s3api/errors.py.
"""

from __future__ import annotations

from xml.sax.saxutils import escape


class S3Error(Exception):
    def __init__(self, code: str, status: int, message: str):
        super().__init__(message)
        self.code = code
        self.status = status
        self.message = message

    def to_xml(self, resource: str = "", request_id: str = "") -> bytes:
        return (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f"<Error><Code>{self.code}</Code>"
            f"<Message>{escape(self.message)}</Message>"
            f"<Resource>{escape(resource)}</Resource>"
            f"<RequestId>{request_id}</RequestId></Error>"
        ).encode()


def _err(code: str, status: int, message: str):
    return lambda: S3Error(code, status, message)


ERRORS = {
    "NoSuchBucket": _err("NoSuchBucket", 404, "The specified bucket does not exist"),
    "NoSuchKey": _err("NoSuchKey", 404, "The specified key does not exist."),
    "NoSuchUpload": _err(
        "NoSuchUpload",
        404,
        "The specified multipart upload does not exist.",
    ),
    "BucketAlreadyExists": _err(
        "BucketAlreadyExists", 409, "The requested bucket name is not available."
    ),
    "BucketNotEmpty": _err(
        "BucketNotEmpty", 409, "The bucket you tried to delete is not empty"
    ),
    "InvalidBucketName": _err(
        "InvalidBucketName", 400, "The specified bucket is not valid."
    ),
    "InvalidMaxKeys": _err(
        "InvalidMaxKeys", 400, "Argument maxKeys must be an integer >= 0"
    ),
    "InvalidPart": _err(
        "InvalidPart",
        400,
        "One or more of the specified parts could not be found.",
    ),
    "InvalidRange": _err(
        "InvalidRange", 416, "The requested range is not satisfiable"
    ),
    "InvalidPartOrder": _err(
        "InvalidPartOrder",
        400,
        "The list of parts was not in ascending order.",
    ),
    "EntityTooSmall": _err(
        "EntityTooSmall",
        400,
        "Your proposed upload is smaller than the minimum allowed object size.",
    ),
    "InternalError": _err(
        "InternalError", 500, "We encountered an internal error, please try again."
    ),
    "RequestTimeout": _err(
        "RequestTimeout",
        400,
        "Your request's X-Weed-Deadline budget expired before it "
        "could be completed.",
    ),
    "AccessDenied": _err("AccessDenied", 403, "Access Denied."),
    "SignatureDoesNotMatch": _err(
        "SignatureDoesNotMatch",
        403,
        "The request signature we calculated does not match the signature you provided.",
    ),
    "InvalidAccessKeyId": _err(
        "InvalidAccessKeyId",
        403,
        "The AWS Access Key Id you provided does not exist in our records.",
    ),
    "MissingFields": _err("MissingFields", 400, "Missing fields in request."),
    "AuthorizationHeaderMalformed": _err(
        "AuthorizationHeaderMalformed",
        400,
        "The authorization header is malformed.",
    ),
    "MalformedXML": _err(
        "MalformedXML",
        400,
        "The XML you provided was not well-formed or did not validate against "
        "our published schema.",
    ),
    "NotImplemented": _err(
        "NotImplemented", 501, "A header you provided implies functionality "
        "that is not implemented"
    ),
    "AuthorizationQueryParametersError": _err(
        "AuthorizationQueryParametersError",
        400,
        "X-Amz-Expires must be an integer between 1 and 604800 seconds.",
    ),
    "InvalidArgument": _err(
        "InvalidArgument",
        400,
        "Part number must be an integer between 1 and 10000, inclusive",
    ),
    "RequestTimeTooSkewed": _err(
        "RequestTimeTooSkewed",
        403,
        "The difference between the request time and the server's time is too large.",
    ),
}


def s3_error(code: str) -> S3Error:
    return ERRORS[code]()
