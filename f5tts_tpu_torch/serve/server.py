"""HTTP serving surface of the port (counterpart of
``f5tts_tpu/serve/server.py``), an aiohttp app over ``serve/service.py``:

- ``POST /v1/audio/speech`` -> WAV (``response_format="stream"``: chunked
  WAV, int16 PCM as each text chunk's solve finishes);
- ``POST /v1/speech_edit`` (multipart ``file`` + ``target_text``, ``parts``
  ``'start,end;start,end'`` seconds, optional ``fix_durations``, ``nfe_step``,
  ``cfg_strength``, ``seed``);
- ``POST /v1/transcribe/``, ``/v1/speech_to_speech``, ``/v1/indic_chat``,
  ``/v1/translate``, ``/v1/visual_query``, ``/v1/document_query_batch``
  (501 unless local model weights are configured);
- ``GET /v1/health``, ``/v1/metrics`` (JSON or ``?format=prometheus``),
  ``/metrics``, ``/``, ``/app``, ``/v1/voices`` (+ ``POST``, ``DELETE
  /v1/voices/{name}``), ``/v1/model``; ``POST /v1/load_all_models``,
  ``/v1/unload_all_models``, ``/v1/load_model``, ``/v1/profiler/start|stop``;
- a timing middleware (``X-Response-Time``), CORS headers, per-route rate
  limits and an optional API key.

This is the only module of the port that imports aiohttp: the service raises
``ServiceError``, mapped here to the status and JSON body the JAX app gives.

    python -m f5tts_tpu_torch.serve.server --demo-tiny --device cpu --port 7860

Without ``--device cpu`` (or ``F5TPU_DEVICE=cpu``) it serves on the GPU, and
raises when none is visible.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import queue
import struct
import threading
import time

from aiohttp import web

from f5tts_tpu_torch.audio.io import encode_pcm16, read_wav, wav_bytes
from f5tts_tpu_torch.serve.schemas import SpeechRequest
from f5tts_tpu_torch.serve.service import ModelService, RateLimiter, ServiceError
from f5tts_tpu_torch.utils.config import Settings, load_deployment_config, parse_arguments

log = logging.getLogger("f5tpu.serve")

_ERRORS = {400: web.HTTPBadRequest, 401: web.HTTPUnauthorized, 404: web.HTTPNotFound,
           429: web.HTTPTooManyRequests, 500: web.HTTPInternalServerError, 501: web.HTTPNotImplemented,
           503: web.HTTPServiceUnavailable}


def http_error(status: int, error: str, **extra) -> web.HTTPException:
    return _ERRORS[status](text=json.dumps({"error": error, **extra}))


async def in_executor(fn, *args):
    """Run a blocking service call on the loop's thread pool, its
    ``ServiceError`` turned into the matching HTTP error."""
    try:
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)
    except ServiceError as e:
        raise _ERRORS[e.status](text=json.dumps(e.body)) from e


@web.middleware
async def timing_middleware(request: web.Request, handler):
    start = time.monotonic()
    try:
        resp = await handler(request)
    except web.HTTPException as e:
        # error responses carry the header too (HTTPExceptions are the responses)
        e.headers["X-Response-Time"] = f"{time.monotonic() - start:.3f}s"
        raise
    finally:
        dur = time.monotonic() - start
        log.info("%s %s took %.3fs", request.method, request.path, dur)
    if not resp.prepared:  # streamed responses flushed their headers already
        resp.headers["X-Response-Time"] = f"{dur:.3f}s"
    return resp


def _cors(headers) -> None:
    headers["Access-Control-Allow-Origin"] = "*"
    headers["Access-Control-Allow-Methods"] = "GET,POST,OPTIONS"
    headers["Access-Control-Allow-Headers"] = "*"


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        try:
            resp = await handler(request)
        except web.HTTPException as e:
            _cors(e.headers)  # a browser client then sees the JSON error body
            raise
    if not resp.prepared:  # streams set their CORS headers before prepare()
        _cors(resp.headers)
    return resp


def build_app(settings: Settings) -> web.Application:
    service = ModelService(settings)
    speech_limiter = RateLimiter(settings.speech_rate_limit)
    chat_limiter = RateLimiter(settings.chat_rate_limit)

    def check_auth(request):
        import hmac

        # bytes: compare_digest on str raises for non-ASCII header values
        supplied = request.headers.get("Authorization", "").encode("utf-8", "surrogateescape")
        expected = f"Bearer {settings.api_key}".encode("utf-8", "surrogateescape")
        if settings.api_key and not hmac.compare_digest(supplied, expected):
            raise http_error(401, "invalid api key")

    async def speech(request: web.Request) -> web.StreamResponse:
        check_auth(request)
        if not speech_limiter.allow(request.remote or "?"):
            raise http_error(429, "rate limit exceeded")
        if not service.loaded:
            raise http_error(503, "TTS model not loaded")
        try:
            req = SpeechRequest.from_body(await request.json())
        except Exception as e:
            raise http_error(400, str(e)) from e
        if not req.effective_text.strip():
            raise http_error(400, "text must not be empty")
        if req.response_format == "stream":
            try:
                sr, segments = service.stream_segments(req)
            except ServiceError as e:
                raise _ERRORS[e.status](text=json.dumps(e.body)) from e
            return await stream_pcm(request, sr, segments)
        data = await in_executor(service.synthesize_sync, req)
        return web.Response(body=data, content_type="audio/wav",
                            headers={"Content-Disposition": 'inline; filename="speech.wav"',
                                     "Cache-Control": "no-cache"})

    async def stream_pcm(request: web.Request, sr: int, segments) -> web.StreamResponse:
        """Chunked WAV: a header with unknown sizes, then int16 PCM from a
        bounded producer queue; a client that disconnects stops the producer.
        ``segments``: zero-arg callable returning an iterator of float32 PCM."""
        resp = web.StreamResponse(headers={"Content-Type": "audio/wav", "Cache-Control": "no-cache"})
        _cors(resp.headers)  # headers flush at prepare(): the middleware cannot add them later
        resp.headers["X-Accel-Buffering"] = "no"
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        await resp.write(b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
                         + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16) + b"data" + struct.pack("<I", 0xFFFFFFFF))
        q: queue.Queue = queue.Queue(maxsize=4)
        abandoned = threading.Event()

        def _put(item) -> bool:
            # a bounded put that gives up once the consumer is gone (a plain
            # put would pin this executor thread after a disconnect)
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for seg in segments():
                    if not _put(encode_pcm16(seg).tobytes()):
                        return
            except Exception as e:  # surfaces as a truncated stream
                log.error("stream synthesis failed: %s", e)
            finally:
                _put(None)

        loop = asyncio.get_running_loop()
        loop.run_in_executor(None, produce)
        try:
            while True:
                chunk = await loop.run_in_executor(None, q.get)
                if chunk is None:
                    break
                await resp.write(chunk)
            await resp.write_eof()
        finally:
            abandoned.set()
            # a cancelled consumer leaves an executor thread parked in q.get:
            # drain, then hand it one sentinel
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            try:
                q.put_nowait(None)
            except queue.Full:
                pass
        return resp

    async def _read_multipart_audio(request: web.Request) -> bytes:
        try:
            reader = await request.multipart()
            field = await reader.next()
        except (AssertionError, ValueError):
            field = None
        if field is None:
            raise http_error(400, "multipart body with an audio file part required")
        return await field.read(decode=True)

    async def _transcribe(request: web.Request) -> str:
        try:
            from f5tts_tpu_torch.serve.asr import transcribe_bytes
        except Exception as e:
            raise http_error(501, "ASR backend unavailable in this build") from e
        audio = await _read_multipart_audio(request)
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, transcribe_bytes, audio, request.query.get("language"))
        except ImportError as e:
            raise http_error(501, str(e)) from e

    async def transcribe(request: web.Request) -> web.Response:
        check_auth(request)
        return web.json_response({"text": await _transcribe(request)})

    async def speech_to_speech(request: web.Request) -> web.StreamResponse:
        check_auth(request)
        if not service.loaded:
            raise http_error(503, "TTS model not loaded")
        text = await _transcribe(request)
        data = await in_executor(service.synthesize_sync, SpeechRequest(text=text, voice=request.query.get("voice")))
        return web.Response(body=data, content_type="audio/wav")

    async def health(request: web.Request) -> web.Response:
        stats = service.batcher.stats if service.batcher else {}
        return web.json_response({
            "status": "healthy" if service.loaded else "idle",
            "model": ("demo_tiny" if settings.demo_tiny else "IndicF5-TPU")
                     + ("-parler" if settings.tts_model == "parler" else ""),
            "device": settings.device,
            "consecutive_failures": service.failures,
            "reloads": service.reloads,
            **stats,
        })

    async def speech_edit(request: web.Request) -> web.Response:
        check_auth(request)
        if settings.tts_model == "parler":
            raise http_error(501, "speech editing is a flow-matching capability; not available on the parler branch")
        if not service.loaded:
            raise http_error(503, "TTS model not loaded")
        form = await request.post()
        upload = form.get("file")
        if upload is None or not hasattr(upload, "file"):
            raise http_error(400, "multipart field 'file' (wav) required")
        target_text = str(form.get("target_text", ""))
        parts_raw = str(form.get("parts", ""))
        if not target_text or not parts_raw:
            raise http_error(400, "need target_text and parts")
        try:
            parts = [tuple(float(x) for x in span.split(",")) for span in parts_raw.split(";") if span]
            fixes = [float(x) for x in str(form.get("fix_durations", "")).split(";") if x] or None
        except ValueError as e:
            raise http_error(400, "bad parts/fix_durations format") from e
        if fixes is not None and len(fixes) != len(parts):
            raise http_error(400, "fix_durations must match parts count")
        audio, sr = read_wav(upload.file.read())

        def run():
            return service.speech_edit_sync(
                audio, sr, target_text, parts, fixes,
                nfe_step=int(form["nfe_step"]) if form.get("nfe_step") else None,
                cfg_strength=float(form.get("cfg_strength", 2.0)),
                seed=int(form["seed"]) if form.get("seed") else None)

        wave, out_sr = await in_executor(run)
        return web.Response(body=wav_bytes(wave, out_sr), content_type="audio/wav")

    async def metrics(request: web.Request) -> web.Response:
        """JSON by default; Prometheus text with ``?format=prometheus`` or at
        ``/metrics``."""
        from f5tts_tpu_torch.utils.profiling import GLOBAL_TIMER

        stages = GLOBAL_TIMER.summary()
        batcher = service.batcher.stats if service.batcher else {}
        escalations = getattr(service.engine, "escalations", 0)
        if request.query.get("format") == "prometheus" or request.path == "/metrics":
            lines = ["# HELP f5tpu_stage_ms per-request stage timings (rolling window)",
                     "# TYPE f5tpu_stage_ms summary"]
            for name, s in sorted(stages.items()):
                for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"), ("1.0", "max_ms")):
                    lines.append(f'f5tpu_stage_ms{{stage="{name}",quantile="{q}"}} {s[key]}')
                lines.append(f'f5tpu_stage_ms_count{{stage="{name}"}} {s["count"]}')
            lines += ["# HELP f5tpu_batcher continuous-batcher counters",
                      "# TYPE f5tpu_batcher_batches_total counter"]
            lines += [f"f5tpu_batcher_{k} {v}" for k, v in sorted(batcher.items())]
            lines += [f"f5tpu_model_loaded {int(service.loaded)}",
                      f"f5tpu_consecutive_failures {service.failures}",
                      f"f5tpu_reloads_total {service.reloads}",
                      f"f5tpu_quality_escalations_total {escalations}"]
            return web.Response(text="\n".join(lines) + "\n", content_type="text/plain", charset="utf-8")
        return web.json_response({"stages": stages, "batcher": batcher, "quality_escalations": escalations})

    async def profiler_start(request: web.Request) -> web.Response:
        check_auth(request)
        from f5tts_tpu_torch.utils.profiling import start_device_trace

        log_dir = request.query.get("dir", os.path.join(os.environ.get("TMPDIR", "/tmp"), "f5tpu_trace"))
        return web.json_response({"started": start_device_trace(log_dir), "dir": log_dir})

    async def profiler_stop(request: web.Request) -> web.Response:
        check_auth(request)
        from f5tts_tpu_torch.utils.profiling import stop_device_trace

        return web.json_response({"stopped": stop_device_trace()})

    async def index(request: web.Request) -> web.Response:
        routes = sorted({f"{r.method} {r.resource.canonical}" for r in app.router.routes() if r.method != "HEAD"})
        return web.json_response({"service": "f5tts-tpu", "endpoints": routes})

    async def webapp(request: web.Request) -> web.Response:
        from f5tts_tpu_torch.serve.webui import PAGE

        return web.Response(text=PAGE, content_type="text/html")

    async def voices(request: web.Request) -> web.Response:
        return web.json_response({"voices": sorted(service.voices)})

    async def add_voice(request: web.Request) -> web.Response:
        check_auth(request)
        form = await request.post()
        upload = form.get("file")
        name = str(form.get("name", "")).strip()
        if upload is None or not hasattr(upload, "file") or not name:
            raise http_error(400, "need multipart fields 'name' and 'file' (wav)")
        try:
            service.add_voice(name, upload.file.read(), str(form.get("ref_text", "")))
        except ValueError as e:
            raise http_error(400, str(e)) from e
        except Exception as e:
            raise http_error(400, f"bad wav: {e}") from e
        return web.json_response({"voices": sorted(service.voices)})

    async def delete_voice(request: web.Request) -> web.Response:
        check_auth(request)
        name = request.match_info["name"]
        try:
            service.remove_voice(name)
        except KeyError as e:
            raise http_error(404, f"unknown voice {name!r}") from e
        except ValueError as e:
            raise http_error(400, str(e)) from e
        return web.json_response({"voices": sorted(service.voices)})

    async def indic_chat(request: web.Request) -> web.Response:
        check_auth(request)
        if not chat_limiter.allow(request.remote or "?"):
            raise http_error(429, "rate limit exceeded")
        body = await request.json()
        prompt = body.get("prompt", "")
        if not prompt or len(prompt) > 100_000:
            raise http_error(400, "prompt must be 1..100k chars")
        try:
            from f5tts_tpu_torch.serve.chat import indic_chat as chat_fn

            reply = await asyncio.get_running_loop().run_in_executor(
                None, chat_fn, prompt, body.get("src_lang", "eng_Latn"))
        except ImportError as e:
            raise http_error(501, str(e)) from e
        return web.json_response({"response": reply})

    async def translate_route(request: web.Request) -> web.Response:
        check_auth(request)
        body = await request.json()
        sentences = body.get("sentences", [])
        src, tgt = body.get("src_lang", ""), body.get("tgt_lang", "")
        if not sentences or not src or not tgt:
            raise http_error(400, "need sentences, src_lang, tgt_lang")
        try:
            from f5tts_tpu_torch.serve.chat import translate as translate_fn

            out = await asyncio.get_running_loop().run_in_executor(None, translate_fn, sentences, src, tgt)
        except ImportError as e:
            raise http_error(501, str(e)) from e
        return web.json_response({"translations": out})

    async def visual_query(request: web.Request) -> web.Response:
        """Image(s) + question -> answer(s): multipart ``file`` part(s) and
        ``query``, ``src_lang``, ``tgt_lang``; 501 without local VLM weights."""
        check_auth(request)
        try:
            reader = await request.multipart()
        except (AssertionError, ValueError) as e:
            raise http_error(400, "multipart body required") from e
        images, query = [], ""
        src, tgt = "eng_Latn", "eng_Latn"
        async for part in reader:
            if part.name == "file":
                images.append(await part.read())
            elif part.name == "query":
                query = (await part.read()).decode()
            elif part.name == "src_lang":
                src = (await part.read()).decode()
            elif part.name == "tgt_lang":
                tgt = (await part.read()).decode()
        if not images or not query:
            raise http_error(400, "need multipart 'file' image(s) and 'query'")
        try:
            import io

            from PIL import Image

            from f5tts_tpu_torch.serve.chat import document_query_batch

            pil = [Image.open(io.BytesIO(b)).convert("RGB") for b in images]
            answers = await asyncio.get_running_loop().run_in_executor(None, document_query_batch, pil, query, src, tgt)
        except ImportError as e:
            raise http_error(501, str(e)) from e
        if request.path.endswith("document_query_batch"):
            return web.json_response({"answers": answers})
        return web.json_response({"answer": answers[0]})

    # one lock for every lifecycle change made through the routes
    model_lock = asyncio.Lock()

    async def load_all(request: web.Request) -> web.Response:
        check_auth(request)
        async with model_lock:
            await in_executor(service.load)
        return web.json_response({"status": "models loaded"})

    async def unload_all(request: web.Request) -> web.Response:
        check_auth(request)
        async with model_lock:
            await in_executor(service.unload)
        return web.json_response({"status": "models unloaded"})

    def _last_model_path() -> str:
        return os.path.join(os.path.expanduser("~"), ".cache", "f5tts_tpu_torch", "last_model.json")

    async def get_model(request: web.Request) -> web.Response:
        """Current and last-used checkpoint paths (auth-gated: they disclose
        server paths)."""
        check_auth(request)
        last = {}
        try:
            with open(_last_model_path(), encoding="utf-8") as f:
                last = json.load(f)
        except (OSError, ValueError):
            pass
        s = service.settings
        return web.json_response({
            "loaded": service.loaded, "demo_tiny": s.demo_tiny, "tts_model": s.tts_model,
            "tts_ckpt": s.tts_ckpt, "tts_vocab": s.tts_vocab, "vocoder_ckpt": s.vocoder_ckpt, "last_used": last,
        })

    async def load_model(request: web.Request) -> web.Response:
        """Hot-swap the served checkpoint: POST {tts_ckpt, tts_vocab,
        vocoder_ckpt, vocoder_type?}; on failure the previous model is loaded
        back."""
        check_auth(request)
        body = await request.json()
        paths = {k: body.get(k, "") for k in ("tts_ckpt", "tts_vocab", "vocoder_ckpt")}
        missing = [k for k, v in paths.items() if not v or not os.path.exists(v)]
        if missing:
            raise http_error(400, f"missing or nonexistent paths: {missing}")
        vocoder_type = body.get("vocoder_type", "vocos")
        if vocoder_type not in ("vocos", "bigvgan"):
            raise http_error(400, f"vocoder_type must be vocos|bigvgan, got {vocoder_type!r}")
        s = service.settings
        prev = (s.tts_ckpt, s.tts_vocab, s.vocoder_ckpt, s.demo_tiny, s.tts_model, s.vocoder_type)

        def _set_new():
            s.tts_ckpt, s.tts_vocab, s.vocoder_ckpt = paths["tts_ckpt"], paths["tts_vocab"], paths["vocoder_ckpt"]
            s.demo_tiny = False
            s.tts_model = "f5"  # the hot-swap route takes f5-family checkpoints
            s.vocoder_type = vocoder_type

        def _set_prev():
            s.tts_ckpt, s.tts_vocab, s.vocoder_ckpt, s.demo_tiny, s.tts_model, s.vocoder_type = prev

        def _swap_with_rollback():
            try:
                service.swap(_set_new)
                return None, ""
            except Exception as e:  # bad checkpoint: restore the previous model
                log.exception("checkpoint load failed; rolling back")
                try:
                    service.swap(_set_prev)
                    return e, "previous model restored"
                except Exception as e2:
                    return e, f"previous model restore also failed: {e2}"

        async with model_lock:
            err, restore = await asyncio.get_running_loop().run_in_executor(None, _swap_with_rollback)
        if err is not None:
            raise http_error(400, f"load failed: {err}", rollback=restore)
        try:
            os.makedirs(os.path.dirname(_last_model_path()), exist_ok=True)
            with open(_last_model_path(), "w", encoding="utf-8") as f:
                json.dump(paths, f)
        except OSError:
            pass
        return web.json_response({"status": "model loaded", **paths})

    app = web.Application(middlewares=[cors_middleware, timing_middleware], client_max_size=64 * 1024 * 1024)
    app.router.add_post("/v1/audio/speech", speech)
    app.router.add_post("/v1/transcribe/", transcribe)
    app.router.add_post("/v1/speech_to_speech", speech_to_speech)
    app.router.add_post("/v1/speech_edit", speech_edit)
    app.router.add_get("/v1/health", health)
    app.router.add_get("/v1/metrics", metrics)
    app.router.add_get("/metrics", metrics)
    app.router.add_post("/v1/profiler/start", profiler_start)
    app.router.add_post("/v1/profiler/stop", profiler_stop)
    app.router.add_get("/", index)
    app.router.add_post("/v1/load_all_models", load_all)
    app.router.add_post("/v1/unload_all_models", unload_all)
    app.router.add_get("/v1/model", get_model)
    app.router.add_post("/v1/load_model", load_model)
    app.router.add_get("/app", webapp)
    app.router.add_get("/v1/voices", voices)
    app.router.add_post("/v1/voices", add_voice)
    app.router.add_delete("/v1/voices/{name}", delete_voice)
    app.router.add_post("/v1/indic_chat", indic_chat)
    app.router.add_post("/v1/translate", translate_route)
    app.router.add_post("/v1/visual_query", visual_query)
    app.router.add_post("/v1/document_query_batch", visual_query)
    app["service"] = service

    async def on_startup(app):
        if not settings.lazy_load_model:
            await asyncio.get_running_loop().run_in_executor(None, service.load)

    async def on_cleanup(app):
        service.unload()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def main(argv=None):
    from f5tts_tpu_torch.utils.device import resolve_device

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = parse_arguments(argv)
    settings = Settings.from_env(host=args.host, port=args.port, tts_ckpt=args.tts_ckpt, tts_vocab=args.tts_vocab,
                                 vocoder_ckpt=args.vocoder_ckpt, voices_dir=args.voices_dir, device=args.device)
    if args.demo_tiny:
        settings.demo_tiny = True
    if args.config and args.config_file:
        settings = load_deployment_config(args.config_file, args.config, settings)
    resolve_device(settings.device)  # no GPU and no --device cpu: raise before serving
    web.run_app(build_app(settings), host=settings.host, port=settings.port)


if __name__ == "__main__":
    main()
